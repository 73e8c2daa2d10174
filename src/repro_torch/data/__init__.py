"""Deterministic synthetic data (numpy only)."""
from repro_torch.data.synthetic import SyntheticImages, SyntheticTokens

__all__ = ["SyntheticImages", "SyntheticTokens"]
