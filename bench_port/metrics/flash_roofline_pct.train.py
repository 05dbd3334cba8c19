from bench_port.readers import kernel_roofline

read = kernel_roofline('train_flash')
