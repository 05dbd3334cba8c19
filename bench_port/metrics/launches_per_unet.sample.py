from bench_port.spans import launches_per_unet as read  # noqa: F401
