"""Training: config, schedules, EMA and the train/val steps."""
