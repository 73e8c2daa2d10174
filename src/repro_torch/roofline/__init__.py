"""Target hardware constants for the modeled latency."""
from repro_torch.roofline.hardware import H100_SXM, Chip

__all__ = ["Chip", "H100_SXM"]
