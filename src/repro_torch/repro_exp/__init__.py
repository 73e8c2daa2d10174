"""The paper's own experiment on the port (Tables I/II)."""
