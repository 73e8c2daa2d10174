"""Training over the LM: AdamW (f32 or INT8 moments), the train step and
the next-token accuracy evaluation the HQP pipeline runs."""
