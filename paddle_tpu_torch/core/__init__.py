"""Device selection, dtypes, random state and the Tensor."""
from . import device, dtype, generator  # noqa: F401
from .tensor import Parameter, Tensor, is_tensor  # noqa: F401
