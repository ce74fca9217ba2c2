"""The port's C and C++ sources: the native search engines (``ffsim.cpp``,
``ffsearch.cpp``) and the C API (``flexflow_c.h``, ``flexflow_c.cpp``,
whose Python side is ``capi.py``), built by ``utils/native.py``."""
