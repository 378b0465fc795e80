"""Architecture config registry: --arch <id> resolution."""

import importlib

ARCHS = [
    "granite-3-2b", "chatglm3-6b", "llama3-405b", "nemotron-4-15b",
    "mamba2-130m", "hymba-1.5b", "qwen3-moe-235b-a22b",
    "granite-moe-1b-a400m", "chameleon-34b", "whisper-large-v3",
]


def _module(arch: str):
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str):
    return _module(arch).CONFIG


def get_reduced(arch: str):
    return _module(arch).reduced()
