from bench_port.readers import setup_s as read  # noqa: F401
