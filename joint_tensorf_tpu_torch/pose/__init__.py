from .test_optim import make_test_time_optimizer  # noqa: F401
