"""CUDA-event timing of module calls, from forward pre-hooks and hooks registered from
outside the program: what implements the module does not change how it is timed."""
import torch


class ModuleEvents:
    def __init__(self, modules, describe):
        self.calls = []
        self.handles = []
        for module in modules:
            self.handles.append(module.register_forward_pre_hook(self._pre))
            self.handles.append(module.register_forward_hook(self._post))
        self.describe = describe
        self._open = []

    def _pre(self, module, args):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        self._open.append((start, self.describe(module, args)))

    def _post(self, module, args, output):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        start, info = self._open.pop()
        self.calls.append((start, end, info))

    def remove(self):
        for h in self.handles:
            h.remove()

    def data(self):
        torch.cuda.synchronize()
        return [{'ms': s.elapsed_time(e), **info} for s, e, info in self.calls]
