"""python -m hank_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

from hank_bench.harness import main  # noqa: E402

sys.exit(main(t_start=T_START))
