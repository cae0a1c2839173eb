"""`paddle.tensor.manipulation` (counterpart of
paddle_tpu/tensor/manipulation.py): the shape ops' module under the
reference's name."""
from ..ops.manipulation import *  # noqa: F401,F403
from ..ops.manipulation import (cast, concat, pad, reshape,  # noqa: F401
                                split, transpose)
