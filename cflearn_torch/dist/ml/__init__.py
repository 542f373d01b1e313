from .experiment import Experiment, ExperimentResults, Task

__all__ = ["Experiment", "ExperimentResults", "Task"]
