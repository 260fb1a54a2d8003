from repro_torch.optim.optimizers import Optimizer, adam, sgd  # noqa: F401
