"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper counts the launches of its kernel in the port's metrics
registry as ``ops.<kernel>.launches`` (the CPU path never counts), and
``ops.nvcc_seconds`` holds the wall time of the kernel build this process
ran (0.0 where it found every library built)."""

from diagon_tpu_torch.observability.metrics import Counter, registry


def launch_counter(kernel: str) -> Counter:
    """The registry counter ``ops.<kernel>.launches``."""
    return registry.counter(f"ops.{kernel}.launches",
                            f"launches of the {kernel} kernel")


def launches(kernel: str) -> int:
    """Launches of ``kernel`` since the process started."""
    return launch_counter(kernel).value()
