"""Training: learning-rate schedules, EMA, the train and eval steps, checkpoints."""
