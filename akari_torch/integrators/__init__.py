from .ao import AOConfig, render_ao
from .path import PathConfig, render, render_sample
