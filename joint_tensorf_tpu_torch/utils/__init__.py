from .cli import run_cli  # noqa: F401
from .torch_setup import resolve_device, setup_torch  # noqa: F401
