from .auth import Auth, CanI, FakeAuth, gvr_from_kind

__all__ = ['Auth', 'CanI', 'FakeAuth', 'gvr_from_kind']
