"""Bitrate accounting of the port (counterpart of
boosting_nerv_tpu/compress/): Huffman code lengths."""
