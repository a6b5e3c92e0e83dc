"""Runtime provider selection (the port's copy of
karpenter_tpu/cloudprovider/registry.py, with the fake provider only: the
AWS, GKE and TPU providers come with a later slice).

reference: pkg/cloudprovider/registry/{aws,fake}.go — the reference selects
its provider at COMPILE time via Go build tags (`-tags=aws`). The TPU build
selects at runtime by name (env KARPENTER_CLOUD_PROVIDER or explicit arg),
defaulting to the not-implemented fake exactly like the `!aws` build.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

from karpenter_tpu_torch.cloudprovider import Options
from karpenter_tpu_torch.cloudprovider.fake import FakeFactory

_providers: Dict[str, Callable[[Options], object]] = {}


def register_provider(name: str, factory_fn: Callable[[Options], object]) -> None:
    _providers[name] = factory_fn


def new_factory(options: Optional[Options] = None, provider: Optional[str] = None):
    options = options or Options()
    name = provider or os.environ.get("KARPENTER_CLOUD_PROVIDER", "")
    if not name:
        return FakeFactory.not_implemented()
    factory_fn = _providers.get(name)
    if factory_fn is None:
        raise ValueError(
            f"unknown cloud provider {name!r}; registered: {sorted(_providers)}"
        )
    return factory_fn(options)


register_provider("fake", lambda options: FakeFactory(options))
