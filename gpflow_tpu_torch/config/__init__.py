from .__config__ import *  # noqa: F401,F403
from .__config__ import __all__  # noqa: F401
