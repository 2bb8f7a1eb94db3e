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
    gp = api.partition(cfg, Fraction(3), 3)    # 3 stages, int8 stream buffers
    logits = api.apply_staged(params, x, cfg, partition=gp,
                              plan=gp.kernel_plan(batch=8), link_quant=True)
    q, s = api.quantize(params)                # int8 weights, one scale each
    logits = api.apply_int8(q, s, x, cfg, plan=kp)
    out, report = api.serve(params, frames, cfg, input_rate=Fraction(3),
                            n_stages=2, rate_matched=True,
                            config=ServeConfig(microbatch=8))

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
    node on its own planned tile.

    ``partition(cfg, input_rate, n_stages, **dse_kwargs)`` is the
    multi-chip front door: the stage-aware DSE cuts the family's DAG into
    ``n_stages`` stages and returns the ``GraphPlan`` with ``stage_plan``
    / ``stream_bufs``; ``apply_staged(params, x, cfg, partition=gp)``
    runs each stage as its own function.  ``quantize`` / ``apply_int8``
    are the int8 weight datapath.  ``serve(params, frames, cfg, *,
    input_rate, n_stages=1, config=ServeConfig(...), **kw)`` streams
    frames through the stream engine (``serving.cnn_stream.serve_frames``)
    on the API's device and returns ``(outputs, report)``.

    ``caches`` memoizes graphs per config and DSE plans per (config,
    rate, stages, kwargs); ``serve`` keys its plans in the same dict per
    (graph, rate, stages, kwargs), the graph being the config's."""

    family: str
    device: torch.device
    make_config: Callable            # (**overrides) -> cfg dataclass
    init: Callable                   # (cfg, generator) -> params on device
    apply: Callable                  # (params, x, cfg, *, conv_impls, plan, ...)
    graph: Callable                  # (cfg) -> LayerGraph (the DSE's view)
    plan: Callable                   # (cfg, input_rate, **kw) -> ImplPlan table
    quantize: Callable               # (params, bits=8) -> (q_params, scales)
    apply_int8: Callable             # (q_params, scales, x, cfg, ...) -> logits
    partition: Callable              # (cfg, input_rate, n_stages, **kw) -> GraphPlan
    apply_staged: Callable           # (params, x, cfg, *, partition, ...)
    serve: Callable                  # (params, frames, cfg, *, input_rate, ...)
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

    def _planned(cfg, input_rate, n_stages, dse_kwargs):
        try:
            key = (cfg, Fraction(input_rate), n_stages,
                   tuple(sorted(dse_kwargs.items())))
            hit = plans.get(key)
        except TypeError:  # unhashable rate/kwargs: plan fresh
            key, hit = None, None
        if hit is None:
            hit = plan_graph(graph(cfg), input_rate, n_stages=n_stages, **dse_kwargs)
            if key is not None:
                plans[key] = hit
        return hit

    def plan(cfg, input_rate, **dse_kwargs):
        return _planned(cfg, input_rate, None, dse_kwargs).kernel_plan()

    def partition(cfg, input_rate, n_stages, **dse_kwargs):
        return _planned(cfg, input_rate, n_stages, dse_kwargs)

    def init(cfg, generator: torch.Generator):
        return mod.init_params(cfg, generator, device)

    def on_device(x):
        return torch.as_tensor(x).to(device)

    def apply(params, x, cfg, **kwargs):
        kwargs.setdefault("graph", graph(cfg))
        return mod.apply(params, on_device(x), cfg, **kwargs)

    def apply_staged(params, x, cfg, **kwargs):
        kwargs.setdefault("graph", graph(cfg))
        return mod.apply_staged(params, on_device(x), cfg, **kwargs)

    def apply_int8(q_params, scales, x, cfg, **kwargs):
        kwargs.setdefault("graph", graph(cfg))
        return mod.apply_int8(q_params, scales, on_device(x), cfg, **kwargs)

    def serve(params, frames, cfg, **kwargs):
        from repro_torch.serving.cnn_stream import serve_frames
        from repro_torch.serving.config import ServeConfig

        config = kwargs.pop("config", None)
        if "dtype" not in kwargs and (config is None or config.dtype is None):
            kwargs["dtype"] = cfg.dtype
        kwargs["config"] = config if config is not None else ServeConfig()
        kwargs.setdefault("plan_cache", plans)
        kwargs.setdefault("device", device)
        return serve_frames(graph(cfg), params, frames, **kwargs)

    return CNNApi(
        family=family,
        device=device,
        make_config=make_config,
        init=init,
        apply=apply,
        graph=graph,
        plan=plan,
        quantize=mod.quantize_params,
        apply_int8=apply_int8,
        partition=partition,
        apply_staged=apply_staged,
        serve=serve,
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
