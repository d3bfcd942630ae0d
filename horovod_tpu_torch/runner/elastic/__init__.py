"""The elastic launcher: host discovery, the driver, and the worker side.

Port of ``horovod_tpu/runner/elastic/``. Importing this package imports
no torch: the driver runs in the launcher process.
"""

from .discovery import (  # noqa: F401
    FixedHostDiscovery,
    HostDiscovery,
    HostDiscoveryScript,
    HostManager,
)
from .driver import ElasticDriver, run_elastic  # noqa: F401
