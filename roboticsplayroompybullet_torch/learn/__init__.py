"""Learning-from-play consumers of the episode-log data pipeline."""
from .lfp import relabel_windows, sample_lfp_batch

__all__ = ["relabel_windows", "sample_lfp_batch"]
