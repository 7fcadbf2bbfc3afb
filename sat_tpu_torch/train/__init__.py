"""sat_tpu_torch.train — see the modules."""
