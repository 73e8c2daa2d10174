"""Train-route steps over the LM (the evaluation the HQP pipeline runs)."""
