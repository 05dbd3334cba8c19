from bench_port.spans import decode_device_ms as read  # noqa: F401
