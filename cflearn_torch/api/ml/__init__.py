"""The tabular APIs (counterpart of `cflearn_tpu/api/ml/`): DDR queries and
figures, and integrated-gradients feature importances."""

from .ddr import DDRPredictor, DDRVisualizer
from .interpreter import IntegratedGradients, Interpreter, integrated_gradients
