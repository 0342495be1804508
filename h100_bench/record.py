"""What a run measured, as the metric readers (`metrics/<name>.py`) read
it. Every time is the host's clock unless a trace's."""

from dataclasses import dataclass, field
from typing import List, Optional

from h100_bench.trace import Trace


@dataclass
class Run:
    workload: str
    config: dict
    traffic: dict
    flops: Optional[dict] = None   # frozen count per image of the cell
    setup_s: float = 0.0           # process start to the first timed item
    build_s: float = 0.0           # the program's builder
    warmup_s: float = 0.0          # warm-up items (checked steps included)
    window_s: float = 0.0          # start of the first timed item to the
    items: int = 0                 # end of the last; requests, steps or
    images: int = 0                # groups finished in it, and their images
    latencies_ms: List[float] = field(default_factory=list)
    trace: Optional[Trace] = None  # the traced items, with --trace 1

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def dtype(self) -> str:
        return self.traffic.get("compute_dtype",
                                 self.config["compute_dtype"])
