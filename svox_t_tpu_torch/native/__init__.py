"""Host C++ tooling of the port (no GPU): the median-cut quantizer."""

from .quantize import quantize_median_cut, quantize_median_cut_plain

__all__ = ["quantize_median_cut", "quantize_median_cut_plain"]
