"""sat_tpu_torch.data — see the modules."""
