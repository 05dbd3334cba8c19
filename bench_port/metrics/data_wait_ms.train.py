from bench_port.spans import data_wait_ms as read  # noqa: F401
