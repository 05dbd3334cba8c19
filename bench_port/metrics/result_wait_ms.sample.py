from bench_port.spans import result_wait_ms as read  # noqa: F401
