"""repro_torch.data — the training data pipeline (host code, NumPy only):
``SyntheticLM``, ``PackedReader`` and ``Prefetcher``."""
from repro_torch.data.pipeline import PackedReader, Prefetcher, SyntheticLM  # noqa: F401
