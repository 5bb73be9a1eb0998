"""CLI argument parsing in the style of ``speechbrain.parse_arguments``
(copy of ``stac_st_tpu/config/arguments.py``).

The reference recipes are driven as
``python train_multitask.py hparams.yaml --key=value ...``
(reference ``stac-st/train_multitask.py:626`` / ``run_default.sh:52-80``).
This parser splits argv into (hparams_file, run_opts, overrides): run-options
are harness-level flags; everything else becomes a YAML override.

``--device`` (default ``cuda``) selects where the recipe runs; ``cpu``
only when asked. The JAX package's other run options are accepted so its
command lines parse unchanged; the port reads ``device``, ``precision``,
``transfer_int16``, ``debug*``, ``noprogressbar``,
``data_parallel_count`` (-1: the process group's world size; any other
value must equal it, the run launched as ``torchrun --nproc_per_node N
-m stac_st_tpu_torch.recipes.train_multitask ...``),
``distributed_backend`` (``nccl``, the default for any other value, or
``gloo``), ``train_attn_kernel`` (``auto``/``on``: the flash kernels;
``off``: the model's matmul + softmax attention), ``rng_impl`` (every
value the JAX trainer takes, served by the port's one counter RNG; another
raises) and ``pipeline_stages`` (> 1 raises: pipeline stages are not
ported). ``compile_cache_dir``, ``jit_compile``, ``profile_dir``,
``find_unused_parameters``, ``distributed_launch`` and ``local_rank`` are
accepted and unused.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

__all__ = ["parse_arguments", "RUN_OPT_DEFAULTS"]

RUN_OPT_DEFAULTS: Dict[str, Any] = {
    "device": "cuda",
    "data_parallel_count": -1,          # -1 = all visible devices
    "distributed_launch": False,        # accepted/ignored (NCCL-era flag)
    "distributed_backend": "ici",       # nccl (any other value) | gloo
    "debug": False,
    "debug_batches": 2,
    "debug_epochs": 2,
    "find_unused_parameters": False,    # accepted/ignored (DDP-era flag)
    "jit_compile": True,
    "precision": "bf16",                # bf16 | fp32
    "rng_impl": "rbg",                  # rbg | unsafe_rbg | threefry | *_scoped
    "train_attn_kernel": "auto",        # auto | on | off (flash train attn)
    "pipeline_stages": 0,               # >0 => pipeline-parallel encoder
    "compile_cache_dir": "",            # non-empty => persistent XLA cache
    "transfer_int16": False,            # ship train audio H2D as PCM16
    "noprogressbar": False,
    "profile_dir": "",                  # accepted/ignored
    "local_rank": 0,                    # accepted/ignored (LOCAL_RANK)
}

_BOOLS = {"true": True, "false": False, "True": True, "False": False}


def _convert(text: str) -> Any:
    if text in _BOOLS:
        return _BOOLS[text]
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def parse_arguments(
    arg_list: List[str],
) -> Tuple[str, Dict[str, Any], Dict[str, Any]]:
    """Split argv into (hparams_file, run_opts, overrides_dict).

    Accepts ``--key=value``, ``--key value`` and bare ``--flag`` (-> True).
    Quoted values keep their string form; numbers/bools are converted for
    run-opts, while overrides stay as raw strings so the YAML loader can
    apply full yaml semantics (lists, tags, ...).
    """
    if not arg_list:
        raise SystemExit("usage: <recipe> <hparams.yaml> [--key=value ...]")
    if arg_list[0] in ("--help", "-h"):
        # argparse-compatible help exit (code 0) so documented commands
        # are --help-checkable (tests/test_runbook.py)
        print(
            "usage: <recipe> <hparams.yaml> [--key=value ...]\n\n"
            "positional arguments:\n"
            "  hparams.yaml     experiment config (hyperpyyaml; the "
            "composition root)\n\n"
            "options:\n"
            "  --key=value      override any scalar hparam key, or set a "
            "run-opt\n"
            "  run-opts: " + ", ".join(sorted(RUN_OPT_DEFAULTS))
        )
        raise SystemExit(0)
    hparams_file = arg_list[0]
    run_opts = dict(RUN_OPT_DEFAULTS)
    overrides: Dict[str, Any] = {}

    i = 1
    while i < len(arg_list):
        arg = arg_list[i]
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected positional argument: {arg!r}")
        key = arg[2:]
        if "=" in key:
            key, value = key.split("=", 1)
        elif i + 1 < len(arg_list) and not arg_list[i + 1].startswith("--"):
            value = arg_list[i + 1]
            i += 1
        else:
            value = "True"
        key = key.replace("-", "_")
        # strip shell-protected quotes, e.g. --languages "'[ES],[EN]'"
        if len(value) >= 2 and value[0] == value[-1] and value[0] in "'\"":
            value = value[1:-1]
        if key in run_opts:
            run_opts[key] = _convert(value)
        else:
            overrides[key] = value
        i += 1

    return hparams_file, run_opts, overrides
