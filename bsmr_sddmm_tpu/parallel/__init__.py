from bsmr_sddmm_tpu.parallel import distributed
from bsmr_sddmm_tpu.parallel.ring import (make_ring_sddmm, pack_ring_plans,
                                          ring_operands)
from bsmr_sddmm_tpu.parallel.sharding import (make_mesh,
                                              make_sharded_sddmm,
                                              shard_device_plan,
                                              shard_operands,
                                              sharded_rphm_to_csr)

__all__ = ["distributed", "make_mesh", "make_sharded_sddmm",
           "make_ring_sddmm", "pack_ring_plans", "ring_operands",
           "shard_device_plan", "shard_operands", "sharded_rphm_to_csr"]
