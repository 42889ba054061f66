"""Single-device training: AdamW, the restart-safe data pipeline with the
paper's table as its n-gram dedup set, the train step and checkpoints."""
