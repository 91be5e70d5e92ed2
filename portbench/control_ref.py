"""portbench/control.py for a cell whose mix runs drivers/serve_ref.py:

    python3 portbench/control_ref.py --workload <cell> --seconds 2 --seeds 11 12 13 \
        [--fault half_batch]

serve_ref serves through serve.py's loop and the program's same predict,
so the faults that portbench/faults.py plants for the serve driver apply
to it as they are; control.py asks faults.py for them by the mix's driver
name, which this script gives as "serve". Everything else is control.py's.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import control, faults  # noqa: E402

_plant = faults.plant


def plant(name: str, driver: str):
    return _plant(name, "serve" if driver == "serve_ref" else driver)


if __name__ == "__main__":
    faults.plant = plant
    control.main()
