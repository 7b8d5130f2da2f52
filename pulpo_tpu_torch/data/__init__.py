"""Data: synthetic pairs, the loader and its device prefetch, and the
OASIS, BraTS and LungCT readers."""
