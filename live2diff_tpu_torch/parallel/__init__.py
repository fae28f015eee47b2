"""Motion-module training: data parallelism, the train step, clip data, checkpoints."""
