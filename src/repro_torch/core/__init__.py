"""Compass DSE core of the torch port: the stream-first scenario API plus
the three engines (BO hardware sampling, GA mapping generation, analytical
evaluation on a torch device).

Typical usage::

    from repro_torch.core import Scenario, RequestStream, explore
    from repro_torch.core.traces import SHAREGPT

    sc = Scenario("mix", spec, target_tops=512,
                  stream=RequestStream("sharegpt", trace=SHAREGPT, rate=0.5),
                  scheduler="chunked_prefill", objective="ttft_p99")
    result = explore(sc)            # on CUDA; explore(sc, device="cpu")
"""
from .compass import (  # noqa: F401
    CO_SEARCH_MODES,
    CompassResult,
    CoSearchConfig,
    MappingSearchOutput,
    Scenario,
    co_explore,
    explore,
    get_co_search,
    hardware_objective,
    scenario_score,
    search_mapping,
)
from .observability import cache_stats  # noqa: F401
from .objectives import (  # noqa: F401
    EDP,
    EDPxMC,
    Energy,
    GoodputUnderSLO,
    Latency,
    Objective,
    TPOTPercentile,
    TTFTPercentile,
    get_objective,
)
from .streams import (  # noqa: F401
    RequestStream,
    RequestTimings,
    StreamRequest,
    StreamRollout,
    mixed_serving_stream,
    rollout,
)
