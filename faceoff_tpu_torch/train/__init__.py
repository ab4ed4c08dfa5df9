"""Training: schedules, the train state, the train step, the trainer's
loop and its observability."""
