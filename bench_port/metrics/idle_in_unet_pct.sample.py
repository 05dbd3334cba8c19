from bench_port.spans import idle_in_unet_pct as read  # noqa: F401
