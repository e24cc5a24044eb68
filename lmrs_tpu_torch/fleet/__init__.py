"""Fleet-level QoS enforcement and elasticity.

The enforcement half of a multi-tenant platform, over the measurement
half in ``obs/`` (the per-request cost ledger and the SLO burn states):

* :mod:`lmrs_tpu_torch.fleet.qos` — fair-share admission over a sliding
  window of ledger device-seconds, ``interactive`` > ``batch`` priority
  classes, and the preemption policy that victimizes over-quota bulk
  work first;
* :mod:`lmrs_tpu_torch.fleet.autoscale` — an elastic pool control loop
  on the router that resizes the pool from measured SLO burn and
  in-flight depth, spawning supervised engines and draining hosts
  before removal.

Both halves are pure policy over existing substrates: ``LMRS_QOS=0``
restores FIFO admission byte-for-byte, ``LMRS_AUTOSCALE=0`` (the
default) never spawns or drains anything.
"""

from lmrs_tpu_torch.fleet.autoscale import (Autoscaler, SupervisedHostPool,
                                            autoscale_enabled,
                                            maybe_autoscaler)
from lmrs_tpu_torch.fleet.qos import (DEFAULT_CLASS, QoSPolicy, class_rank,
                                      clean_qos_class, maybe_qos,
                                      qos_enabled)

__all__ = ["Autoscaler", "DEFAULT_CLASS", "QoSPolicy",
           "SupervisedHostPool", "autoscale_enabled", "class_rank",
           "clean_qos_class", "maybe_autoscaler", "maybe_qos",
           "qos_enabled"]
