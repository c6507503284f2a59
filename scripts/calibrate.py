"""Fit the cost-table row of the current device (autotune.calibrate) and
print it as one JSON line, with the card's name and power limit.

    python scripts/calibrate.py

Commit the row to ``bsmr_sddmm_tpu.autotune.COSTS`` under the printed
``device_kind``, with the card's name and power limit beside it.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import jax

    from bsmr_sddmm_tpu import autotune
    from bsmr_sddmm_tpu.utils.compilecache import enable_compile_cache
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("calibrate.py measures an accelerator; JAX found none",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    row = autotune.calibrate()
    print(json.dumps({"device_kind": dev.device_kind, "nvidia_smi": smi,
                      "row": row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
