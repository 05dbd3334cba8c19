from bench_port.readers import units_per_s as read  # noqa: F401
