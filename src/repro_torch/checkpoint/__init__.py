from repro_torch.checkpoint.npz import load_checkpoint, save_checkpoint  # noqa: F401
