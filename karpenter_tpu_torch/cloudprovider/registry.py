"""Runtime provider selection (the port's copy of
karpenter_tpu/cloudprovider/registry.py).

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


def _aws_factory(options: Options):
    from karpenter_tpu_torch.cloudprovider.aws import AWSFactory

    # registry selection = the operator explicitly chose this provider, so
    # live SDK clients are wanted (reference: factory.go builds a session)
    return AWSFactory(options, sdk_autobind=True)


def _tpu_factory(options: Options):
    from karpenter_tpu_torch.cloudprovider.tpu import TPUFactory

    return TPUFactory(options, sdk_autobind=True)


register_provider("fake", lambda options: FakeFactory(options))
register_provider("aws", _aws_factory)
register_provider("tpu", _tpu_factory)
