"""Data: synthetic pairs, the loader and its device prefetch, readers."""


def reader_not_ported(dataset: str) -> NotImplementedError:
    """The error for a dataset whose reader the port does not have yet."""
    return NotImplementedError(
        f"the {dataset} reader is not ported yet (ROADMAP Queue 1 item 5); "
        "the port reads lungct and synthetic")
