from .mesh import Evaluator, test_classification  # noqa: F401
from .serve import ServingEngine  # noqa: F401
