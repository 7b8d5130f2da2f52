"""Evaluation: metrics, tables and the Evaluate driver."""
