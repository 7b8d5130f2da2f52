"""Evaluation: metrics, tables, figures, artifacts and the Evaluate driver."""
