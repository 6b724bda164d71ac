"""Plain float32 references of the configurations' families, one module a
family (``ModelConfig.family``), importing nothing of the program."""
