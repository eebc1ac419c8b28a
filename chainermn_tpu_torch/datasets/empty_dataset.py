"""Empty dataset (reference ``chainermn/datasets/empty_dataset.py``):
keeps a training loop's iterator cadence without feeding real data."""


def create_empty_dataset(dataset):
    """A dataset of ``len(dataset)`` empty tuples."""
    return [()] * len(dataset)
