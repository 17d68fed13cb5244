"""Host-side utilities: spaces, checkpointing, metrics, profiling."""
from .checkpoint import save_pytree, load_pytree
from .metrics import JsonlSink, play_element_bits
from .profiling import timeit, trace

__all__ = ["save_pytree", "load_pytree", "JsonlSink", "play_element_bits",
           "timeit", "trace"]
