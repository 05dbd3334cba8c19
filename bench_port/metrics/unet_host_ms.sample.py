from bench_port.spans import unet_host_ms as read  # noqa: F401
