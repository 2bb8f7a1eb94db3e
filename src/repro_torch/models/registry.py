"""The front doors, as in the JAX package: ``get_api`` for the LM families
and ``get_cnn_api`` for the CNN families.

    api = get_api(cfg)                         # LM serving, on the card
    params = api.init(cfg, torch.Generator("cuda").manual_seed(0))
    state = api.make_serve_state(cfg, batch, max_len)
    logits, state = api.prefill(params, {"tokens": toks}, state, cfg)
    logits, state = api.decode(params, state, {"tokens": tok}, pos, cfg)

    api = get_cnn_api("mobilenet_v2")          # on the card ("cuda")
    cfg = api.make_config()                    # 224x224, 1000 classes
    params = api.init(cfg, torch.Generator().manual_seed(0))
    kp = api.plan(cfg, Fraction(3))            # per-node ImplPlan table
    logits = api.apply(params, x, cfg, plan=kp)   # rate-matched kernels

``get_api(cfg, device=None)`` and ``get_cnn_api(family, device=None)``
resolve ``None`` to ``"cuda"`` and raise where CUDA is absent: the port's
entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do),
where every kernel runs its plain PyTorch version.  There is no silent
CPU path.
"""
from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.graph import plan_graph
from repro_torch.models import hybrid, lm, mamba, mobilenet, resnet


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; a CUDA device needs CUDA to be present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card unless the "
            "caller asks for the CPU (device='cpu')"
        )
    return dev


def _not_yet(what: str, item: str) -> Callable:
    def missing(*args, **kwargs):
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP: {item})"
        )
    return missing


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    """The LM families' uniform surface (the JAX package's ``ModelAPI``)."""

    init: Callable                    # (cfg, generator) -> params on device
    loss_fn: Callable                 # not ported yet: raises
    make_serve_state: Callable        # (cfg, batch, max_len) -> caches / state
    prefill: Callable                 # (params, batch, state, cfg)
    decode: Callable                  # (params, state, batch, pos, cfg)


# family -> (model module, its serve-state constructor (cfg, batch, max_len, device))
_LM_FAMILIES: Dict[str, Tuple[Any, Callable]] = {
    "lm": (lm, lambda cfg, b, ml, dev: lm.init_cache(cfg, b, ml, device=dev)),
    "ssm": (mamba, lambda cfg, b, ml, dev: mamba.init_state(cfg, b, device=dev)),
    "hybrid": (hybrid, lambda cfg, b, ml, dev: hybrid.init_state(cfg, b, ml, device=dev)),
}
_NOT_PORTED_FAMILIES = {"encdec": "encdec and vlm families",
                        "vlm": "encdec and vlm families"}


def get_api(cfg, device=None) -> ModelAPI:
    """The LM API for ``cfg`` (families lm, ssm and hybrid), its tensors on
    ``device`` (the card unless the caller asks for the CPU).
    ``batch["tokens"]`` may be any integer array; it is moved to the
    device."""
    if cfg.family in _NOT_PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (ROADMAP Queue 1: "
            f"{_NOT_PORTED_FAMILIES[cfg.family]})")
    if cfg.family not in _LM_FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r}")
    mod, make_state = _LM_FAMILIES[cfg.family]
    dev = resolve_device(device)

    def tokens(batch):
        return torch.as_tensor(batch["tokens"]).to(dev, torch.long)

    return ModelAPI(
        init=lambda cfg, generator: mod.init(cfg, generator, dev),
        loss_fn=_not_yet("loss_fn", "training and infrastructure"),
        make_serve_state=lambda cfg, b, ml: make_state(cfg, b, ml, dev),
        prefill=lambda p, batch, st, cfg: mod.prefill(p, tokens(batch), cfg, st),
        decode=lambda p, st, batch, pos, cfg: mod.decode_step(
            p, st, tokens(batch), pos, cfg),
    )


@dataclasses.dataclass(frozen=True)
class CNNApi:
    """Uniform surface over the CNN families (the JAX package's
    ``registry.CNNApi``).  ``plan(cfg, input_rate, **dse_kwargs)`` runs
    the DAG DSE on the family's graph and lowers it to the per-node
    ``ImplPlan`` table; ``apply(..., plan=kp)`` runs every arithmetic
    node on its own planned tile.  ``caches`` memoizes graphs per config
    and DSE plans per (config, rate, kwargs)."""

    family: str
    device: torch.device
    make_config: Callable            # (**overrides) -> cfg dataclass
    init: Callable                   # (cfg, generator) -> params on device
    apply: Callable                  # (params, x, cfg, *, conv_impls, plan, ...)
    graph: Callable                  # (cfg) -> LayerGraph (the DSE's view)
    plan: Callable                   # (cfg, input_rate, **kw) -> ImplPlan table
    quantize: Callable               # not ported yet: raises
    apply_int8: Callable             # not ported yet: raises
    partition: Callable              # not ported yet: raises
    apply_staged: Callable           # not ported yet: raises
    serve: Callable                  # not ported yet: raises
    caches: Any = None               # {"graphs", "plans"} memo dicts


def _cnn_api(family: str, make_config: Callable, mod, device) -> CNNApi:
    graphs: Dict[Any, Any] = {}
    plans: Dict[Any, Any] = {}

    def graph(cfg):
        try:
            hit = graphs.get(cfg)
        except TypeError:  # unhashable config: build fresh, skip the memo
            return cfg.graph()
        if hit is None:
            hit = cfg.graph()
            graphs[cfg] = hit
        return hit

    def _planned(cfg, input_rate, dse_kwargs):
        try:
            key = (cfg, Fraction(input_rate), tuple(sorted(dse_kwargs.items())))
            hit = plans.get(key)
        except TypeError:  # unhashable rate/kwargs: plan fresh
            key, hit = None, None
        if hit is None:
            hit = plan_graph(graph(cfg), input_rate, **dse_kwargs)
            if key is not None:
                plans[key] = hit
        return hit

    def plan(cfg, input_rate, **dse_kwargs):
        return _planned(cfg, input_rate, dse_kwargs).kernel_plan()

    def init(cfg, generator: torch.Generator):
        return mod.init_params(cfg, generator, device)

    def apply(params, x, cfg, **kwargs):
        kwargs.setdefault("graph", graph(cfg))
        return mod.apply(params, torch.as_tensor(x).to(device), cfg, **kwargs)

    return CNNApi(
        family=family,
        device=device,
        make_config=make_config,
        init=init,
        apply=apply,
        graph=graph,
        plan=plan,
        quantize=_not_yet("quantize", "int8 datapath"),
        apply_int8=_not_yet("apply_int8", "int8 datapath"),
        partition=_not_yet("partition", "staged execution"),
        apply_staged=_not_yet("apply_staged", "staged execution"),
        serve=_not_yet("serve", "stream engine"),
        caches={"graphs": graphs, "plans": plans},
    )


_CNN_FAMILIES: Dict[str, Tuple[Callable, Any]] = {
    "mobilenet_v1": (functools.partial(mobilenet.MobileNetConfig, version=1), mobilenet),
    "mobilenet_v2": (functools.partial(mobilenet.MobileNetConfig, version=2), mobilenet),
    "resnet18": (functools.partial(resnet.ResNetConfig, depth=18), resnet),
    "resnet34": (functools.partial(resnet.ResNetConfig, depth=34), resnet),
}


def cnn_families() -> Tuple[str, ...]:
    return tuple(sorted(_CNN_FAMILIES))


def get_cnn_api(name: str, device=None) -> CNNApi:
    try:
        make_config, mod = _CNN_FAMILIES[name]
    except KeyError:
        raise KeyError(
            f"unknown CNN family {name!r}; known: {', '.join(cnn_families())}"
        ) from None
    return _cnn_api(name, make_config, mod, resolve_device(device))
