from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm, cosine_schedule  # noqa: F401
