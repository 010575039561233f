"""Process topology: the torch.distributed bootstrap and PS mode's roles."""
