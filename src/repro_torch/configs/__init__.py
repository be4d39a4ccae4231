"""Architecture configs: one module per assigned arch (+ shapes).

Each module exports CONFIG (the exact published configuration) and
smoke_config() (a reduced same-family config for CPU tests).
"""
from importlib import import_module

ARCHS = [
    "whisper_base", "granite_moe_1b_a400m", "kimi_k2_1t_a32b",
    "command_r_plus_104b", "h2o_danube_3_4b", "gemma2_9b", "chatglm3_6b",
    "recurrentgemma_2b", "xlstm_1_3b", "llama_3_2_vision_11b",
]

#: --arch <id> aliases (dashes/dots as in the assignment table)
ALIASES = {
    "whisper-base": "whisper_base",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "command-r-plus-104b": "command_r_plus_104b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "gemma2-9b": "gemma2_9b",
    "chatglm3-6b": "chatglm3_6b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-1.3b": "xlstm_1_3b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
}


def get_config(arch: str, smoke: bool = False):
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    mod = import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke_config() if smoke else mod.CONFIG


def all_arch_ids():
    return list(ALIASES)
