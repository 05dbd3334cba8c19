from bench_port.readers import loader_wait_ms as read  # noqa: F401
