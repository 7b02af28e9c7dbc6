"""The breadth-first checker."""
