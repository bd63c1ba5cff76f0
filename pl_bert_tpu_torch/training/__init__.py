"""The train and eval steps (train_step.py) over the port's model, and
the step profiler (profile.py)."""
