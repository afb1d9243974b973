"""The port's route table (models/router.py)."""
