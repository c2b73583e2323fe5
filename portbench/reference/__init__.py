"""The plain reference: the configuration's forward pass in f32 plain
PyTorch, W8A8 worked out from the float weights, with no kernel, cache or
batching of the program. It imports nothing of the program."""
