"""The port's native (C++) data plane for the manifest dataset: Pillow's
BILINEAR resample with the normalize, and the PNG scanline unfilter
(``preproc.cpp``), built from source with the host's g++ at first use."""
