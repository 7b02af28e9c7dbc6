"""TLC .cfg parsing and model instantiation; device timing (timing.py)."""
