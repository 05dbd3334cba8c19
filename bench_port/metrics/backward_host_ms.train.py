from bench_port.spans import backward_host_ms as read  # noqa: F401
