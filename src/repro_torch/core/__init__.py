"""HQP core: Fisher sensitivity, structural pruning, Algorithm 1."""
