from .intersect import Hit, intersect, moller_trumbore, occlude
