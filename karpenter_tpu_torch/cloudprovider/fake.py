"""Fake cloud provider for tests and the not-implemented default (the
port's copy of karpenter_tpu/cloudprovider/fake.py).

reference: pkg/cloudprovider/fake/{factory,nodegroup,queue,errors}.go —
in-memory node groups with injectable errors and a stability toggle, fake
queues, and a retryable-error helper.
"""

from __future__ import annotations

from typing import Dict, Optional

from karpenter_tpu_torch.api.metricsproducer import FAKE_QUEUE_TYPE, register_queue_validator
from karpenter_tpu_torch.api.scalablenodegroup import (
    FAKE_NODE_GROUP,
    register_scalable_node_group_validator,
)
from karpenter_tpu_torch.cloudprovider import Options
from karpenter_tpu_torch.controllers.errors import RetryableError
from karpenter_tpu_torch.faults import inject
from karpenter_tpu_torch.recovery.fence import FenceValidator

# Providers register admission validators for the types they serve
# (reference: pkg/cloudprovider/aws/sqsqueue.go:29-34 init pattern).
register_scalable_node_group_validator(FAKE_NODE_GROUP, lambda spec: None)
register_queue_validator(FAKE_QUEUE_TYPE, lambda spec: None)

NOT_IMPLEMENTED_ERROR = RuntimeError(
    "provider is not implemented. Are you running the correct release for "
    "your cloud provider?"
)

NODE_GROUP_MESSAGE = "fake factory message"


class FakeNodeGroup:
    def __init__(self, factory: "FakeFactory", group_id: str):
        self._factory = factory
        self._id = group_id

    def get_replicas(self) -> int:
        inject("cloud.get_replicas")
        if self._factory.want_err is not None:
            raise self._factory.want_err
        replicas = self._factory.node_replicas.get(self._id)
        if replicas is None:
            raise RuntimeError(
                "Replicas for FakeNodeGroup was unset; "
                "try setting FakeFactory.node_replicas."
            )
        return replicas

    def set_replicas(self, count: int, token=None) -> None:
        # actuation fence (karpenter_tpu/recovery): verified FIRST —
        # before fault injection, like the AWS/TPU providers — so a
        # stale incarnation's call is rejected without consuming a
        # chaos plan's injection budget, and chaos runs mixing fault
        # plans with fencing behave identically across providers.
        # Unstamped calls (token None) pass unchecked.
        self._factory.fence_validator.admit(token)
        # inject BEFORE applying: a failed provider call must be atomic
        # (no partially-applied resize), so retry-vs-duplicate actuation
        # is observable in chaos runs
        inject("cloud.set_replicas")
        if self._factory.want_err is not None:
            raise self._factory.want_err
        self._factory.node_replicas[self._id] = count

    def stabilized(self):
        if self._factory.node_group_stable:
            return True, ""
        return False, NODE_GROUP_MESSAGE

    def template(self):
        """Injectable node shape (cloudprovider.NodeTemplate) for
        scale-from-zero tests; None when unset, like a provider that
        can't know its instance shape."""
        if self._factory.want_err is not None:
            raise self._factory.want_err
        return self._factory.node_templates.get(self._id)


class FakeQueue:
    def __init__(self, queue_id: str, want_err: Optional[Exception], length: int = 0,
                 oldest_age: int = 0):
        self._id = queue_id
        self._want_err = want_err
        self.queue_length = length
        self.oldest_age = oldest_age

    def name(self) -> str:
        return self._id

    def length(self) -> int:
        if self._want_err is not None:
            raise self._want_err
        return self.queue_length

    def oldest_message_age_seconds(self) -> int:
        if self._want_err is not None:
            raise self._want_err
        return self.oldest_age


class FakeFactory:
    """In-memory provider with error + stability injection."""

    def __init__(self, options: Optional[Options] = None):
        self.want_err: Optional[Exception] = None
        self.node_replicas: Dict[str, int] = {}
        self.node_templates: Dict[str, object] = {}  # id -> NodeTemplate
        self.node_group_stable = True
        self.queue_lengths: Dict[str, int] = {}
        self.queue_oldest_ages: Dict[str, int] = {}
        # the cloud is shared infrastructure: every controller
        # incarnation actuating through this factory races one fence
        # (karpenter_tpu/recovery/fence.py)
        self.fence_validator = FenceValidator()

    @classmethod
    def not_implemented(cls) -> "FakeFactory":
        factory = cls()
        factory.want_err = NOT_IMPLEMENTED_ERROR
        return factory

    def node_group_for(self, spec) -> FakeNodeGroup:
        return FakeNodeGroup(self, spec.id)

    def queue_for(self, spec) -> FakeQueue:
        return FakeQueue(
            spec.id,
            self.want_err,
            length=self.queue_lengths.get(spec.id, 0),
            oldest_age=self.queue_oldest_ages.get(spec.id, 0),
        )


def retryable_error(message: str) -> RetryableError:
    """reference: fake/errors.go:30-32"""
    return RetryableError(message, code=message)
