from bench_port.readers import seconds_per_request as read  # noqa: F401
