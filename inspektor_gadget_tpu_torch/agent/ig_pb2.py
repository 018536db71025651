# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ig.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x08ig.proto\x12\x05igtpu\"\xc7\x01\n\x10GadgetRunRequest\x12\x10\n\x08\x63\x61tegory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x33\n\x06params\x18\x03 \x03(\x0b\x32#.igtpu.GadgetRunRequest.ParamsEntry\x12\x0f\n\x07timeout\x18\x04 \x01(\x01\x12\x0e\n\x06run_id\x18\x05 \x01(\t\x12\x0e\n\x06output\x18\x06 \x03(\t\x1a-\n\x0bParamsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"Y\n\x14GadgetControlRequest\x12&\n\x03run\x18\x01 \x01(\x0b\x32\x17.igtpu.GadgetRunRequestH\x00\x12\x0e\n\x04stop\x18\x02 \x01(\x08H\x00\x42\t\n\x07request\"9\n\x0bGadgetEvent\x12\x0c\n\x04type\x18\x01 \x01(\r\x12\x0b\n\x03seq\x18\x02 \x01(\x04\x12\x0f\n\x07payload\x18\x03 \x01(\x0c\"\x10\n\x0e\x43\x61talogRequest\"$\n\x0c\x43\x61talogReply\x12\x14\n\x0c\x63\x61talog_json\x18\x01 \x01(\x0c\"\xe1\x01\n\x13\x43ontainerDefinition\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0b\n\x03pid\x18\x03 \x01(\r\x12\r\n\x05mntns\x18\x04 \x01(\x04\x12\r\n\x05netns\x18\x05 \x01(\x04\x12\x11\n\tnamespace\x18\x06 \x01(\t\x12\x0b\n\x03pod\x18\x07 \x01(\t\x12\x36\n\x06labels\x18\x08 \x03(\x0b\x32&.igtpu.ContainerDefinition.LabelsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x1f\n\x0e\x43ontainerReply\x12\r\n\x05\x64\x65\x62ug\x18\x01 \x01(\t2\x8f\x01\n\rGadgetManager\x12:\n\nGetCatalog\x12\x15.igtpu.CatalogRequest\x1a\x13.igtpu.CatalogReply\"\x00\x12\x42\n\tRunGadget\x12\x1b.igtpu.GadgetControlRequest\x1a\x12.igtpu.GadgetEvent\"\x00(\x01\x30\x01\x32\x9f\x01\n\x10\x43ontainerManager\x12\x43\n\x0c\x41\x64\x64\x43ontainer\x12\x1a.igtpu.ContainerDefinition\x1a\x15.igtpu.ContainerReply\"\x00\x12\x46\n\x0fRemoveContainer\x12\x1a.igtpu.ContainerDefinition\x1a\x15.igtpu.ContainerReply\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ig_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _GADGETRUNREQUEST_PARAMSENTRY._options = None
  _GADGETRUNREQUEST_PARAMSENTRY._serialized_options = b'8\001'
  _CONTAINERDEFINITION_LABELSENTRY._options = None
  _CONTAINERDEFINITION_LABELSENTRY._serialized_options = b'8\001'
  _GADGETRUNREQUEST._serialized_start=20
  _GADGETRUNREQUEST._serialized_end=219
  _GADGETRUNREQUEST_PARAMSENTRY._serialized_start=174
  _GADGETRUNREQUEST_PARAMSENTRY._serialized_end=219
  _GADGETCONTROLREQUEST._serialized_start=221
  _GADGETCONTROLREQUEST._serialized_end=310
  _GADGETEVENT._serialized_start=312
  _GADGETEVENT._serialized_end=369
  _CATALOGREQUEST._serialized_start=371
  _CATALOGREQUEST._serialized_end=387
  _CATALOGREPLY._serialized_start=389
  _CATALOGREPLY._serialized_end=425
  _CONTAINERDEFINITION._serialized_start=428
  _CONTAINERDEFINITION._serialized_end=653
  _CONTAINERDEFINITION_LABELSENTRY._serialized_start=608
  _CONTAINERDEFINITION_LABELSENTRY._serialized_end=653
  _CONTAINERREPLY._serialized_start=655
  _CONTAINERREPLY._serialized_end=686
  _GADGETMANAGER._serialized_start=689
  _GADGETMANAGER._serialized_end=832
  _CONTAINERMANAGER._serialized_start=835
  _CONTAINERMANAGER._serialized_end=994
# @@protoc_insertion_point(module_scope)
