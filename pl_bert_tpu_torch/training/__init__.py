"""The Trainer entry point (train.py) over the train and eval steps
(train_step.py), checkpoints (checkpoint.py), the metrics log
(metrics.py) and the step profiler (profile.py)."""
