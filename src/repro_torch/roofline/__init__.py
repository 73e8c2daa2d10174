"""Target hardware constants and the count of a step's work."""
from repro_torch.roofline import cost
from repro_torch.roofline.cost import roofline_terms
from repro_torch.roofline.hardware import H100_SXM, Chip

__all__ = ["Chip", "H100_SXM", "cost", "roofline_terms"]
