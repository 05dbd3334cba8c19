from bench_port.spans import text_host_ms as read  # noqa: F401
