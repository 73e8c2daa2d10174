"""Dense GQA decoder: layers, attention with a KV cache, the LM."""
