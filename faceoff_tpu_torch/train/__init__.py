"""Training: schedules, the train state and the train step."""
