"""The plain fp32 reference the benchmark judges the program against."""
