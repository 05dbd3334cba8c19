from bench_port.readers import mfu as read  # noqa: F401
