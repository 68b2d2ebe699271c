"""The plain reference that decides `correct` (pipeline.py), built on
frozen copies of the port's plain code (frozen/, see its README)."""
