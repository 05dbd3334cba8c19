from bench_port.spans import optimizer_host_ms as read  # noqa: F401
