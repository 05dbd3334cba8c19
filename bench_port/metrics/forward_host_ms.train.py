from bench_port.spans import forward_host_ms as read  # noqa: F401
