"""TLC .cfg parsing and model instantiation."""
