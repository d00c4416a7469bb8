"""Training: losses, mixup, schedules, the AdamW + EMA update and the steps."""
