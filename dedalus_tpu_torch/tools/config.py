"""
Configuration cascade (counterpart of dedalus_tpu/tools/config.py).

Reads the package defaults, then a local ./dedalus_tpu_torch.cfg in the
working directory. Exposes a ConfigParser `config`.
"""

import pathlib
from configparser import ConfigParser

config = ConfigParser()
config.optionxform = str  # preserve key case

_here = pathlib.Path(__file__).parent.parent
config.read(str(_here / "dedalus_tpu_torch.cfg"))
config.read("dedalus_tpu_torch.cfg")
