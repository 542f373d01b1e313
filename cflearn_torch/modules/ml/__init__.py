from . import ddr, fcnn, linear, nets
