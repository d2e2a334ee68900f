"""Synthetic data pipeline (counterpart of ``repro.data``)."""

from .pipeline import Prefetcher, SyntheticLM, host_shard, make_batch

__all__ = ["SyntheticLM", "make_batch", "host_shard", "Prefetcher"]
