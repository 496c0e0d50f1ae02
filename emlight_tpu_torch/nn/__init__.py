from .densenet import DenseNet  # noqa: F401
from .spade import SPADEGenerator  # noqa: F401
