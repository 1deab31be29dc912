"""Observer: per-iteration reconstruction monitoring.

API-parity port of the reference Observer (nsol/observer.py:18-161): records
the iterate trajectory via ``add_x``, evaluates a dict of measures lazily
over the whole trajectory, and stores the solver's wall-clock time.

Difference: solvers normally record scalar measures *in-graph*
during the scanned loop and hand the stacked arrays to
``set_precomputed_measures`` — the host-side trajectory copy (an O(n)
device→host transfer per iteration in the reference) is opt-in via the
solver's ``record_trajectory`` flag.
"""

import numpy as np

__all__ = ["Observer"]


class Observer(object):

    def __init__(self, name=None):
        self._name = name
        self._x_list = []
        self._measures = {}
        self._measures_results = None
        self._computational_time = None

    # -- reference-parity surface (nsol/observer.py) -----------------------

    def set_name(self, name):
        self._name = name

    def get_name(self):
        return self._name

    def add_x(self, x):
        """Append a copy of the current iterate (nsol/observer.py:42-43)."""
        self._x_list.append(np.array(x))

    def get_x_list(self):
        return list(self._x_list)

    def clear_x_list(self):
        self._x_list = []

    def set_measures(self, measures):
        """``measures``: dict name -> callable(x) -> scalar."""
        self._measures = dict(measures)
        self._measures_results = None

    def clear_results(self):
        self._measures_results = None

    def get_measures(self):
        return dict(self._measures)

    def set_computational_time(self, computational_time):
        self._computational_time = computational_time

    def get_computational_time(self):
        return self._computational_time

    def compute_measures(self):
        """Lazily evaluate every measure over the whole trajectory
        (nsol/observer.py:111-119) unless the solver already provided
        in-graph results."""
        if self._measures_results is None:
            self._measures_results = {}
        for name, fn in self._measures.items():
            if name not in self._measures_results:
                self._measures_results[name] = np.array(
                    [float(fn(x)) for x in self._x_list])
        return self._measures_results

    def get_measures_results(self):
        return self.compute_measures()

    # -- in-graph measures extension---------------------------------------

    def set_precomputed_measures(self, results):
        """Install measure arrays computed in-graph by a scanned solver.

        ``results``: dict name -> (iterations+1,) array.
        """
        if self._measures_results is None:
            self._measures_results = {}
        for name, arr in results.items():
            self._measures_results[name] = np.asarray(arr)
