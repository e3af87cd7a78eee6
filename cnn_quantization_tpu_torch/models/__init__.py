from .zoo import available_archs, build_model
