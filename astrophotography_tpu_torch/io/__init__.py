"""Host-side I/O: FITS codec, RAW container decode, image writing, EXIF.

Everything in this subpackage runs on the host CPU; arrays cross to the
device only through the ops/ and models/ layers.
"""

from .fits import (
    Header,
    ImageHDU,
    BinTableHDU,
    HDUList,
    open_fits,
    read_image,
    read_image_device,
    write_image,
)

__all__ = [
    "Header",
    "ImageHDU",
    "BinTableHDU",
    "HDUList",
    "open_fits",
    "read_image",
    "read_image_device",
    "write_image",
]
