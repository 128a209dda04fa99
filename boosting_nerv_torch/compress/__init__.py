"""Bitrate accounting of the port (counterpart of
boosting_nerv_tpu/compress/): Huffman code lengths, and the rANS codec of
the CEM coding eval (``rans``, a C++ library built at first use)."""
