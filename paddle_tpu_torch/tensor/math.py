"""`paddle.tensor.math` (counterpart of paddle_tpu/tensor/math.py): the
math ops' module under the reference's name."""
from ..ops.math import *  # noqa: F401,F403
from ..ops.math import abs_, max_, min_, pow_, round_, sum_  # noqa: F401
