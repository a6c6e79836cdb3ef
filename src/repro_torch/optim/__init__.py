"""AdamW and the learning-rate and batch-size schedules."""
